-- Synthetic JOB-shaped query s21, modelled on JOB family 21 (Leis et al.,
-- VLDB 2015): movie_link and movie_info under company and keyword
-- filters. Written for this repository; not a JOB query.
SELECT MIN(cn.name) AS company_name,
       MIN(lt.link) AS link_type,
       MIN(t.title) AS remade_movie
FROM company_name AS cn,
     company_type AS ct,
     keyword AS k,
     link_type AS lt,
     movie_companies AS mc,
     movie_info AS mi,
     movie_keyword AS mk,
     movie_link AS ml,
     title AS t
WHERE cn.country_code != '[ru]'
  AND (cn.name LIKE '%Pictures%' OR cn.name LIKE '%Entertainment%')
  AND ct.kind = 'production companies'
  AND k.keyword IN ('remake', 'based-on-play')
  AND lt.link LIKE '%remake%'
  AND mc.note IS NULL
  AND mi.info IN ('Canada', 'Australia', 'Ireland', 'English')
  AND t.production_year BETWEEN 1970 AND 2010
  AND lt.id = ml.link_type_id
  AND ml.movie_id = t.id
  AND t.id = mk.movie_id
  AND mk.keyword_id = k.id
  AND t.id = mc.movie_id
  AND mc.company_type_id = ct.id
  AND mc.company_id = cn.id
  AND mi.movie_id = t.id
  AND ml.movie_id = mk.movie_id
  AND ml.movie_id = mc.movie_id
  AND mk.movie_id = mc.movie_id
  AND ml.movie_id = mi.movie_id
  AND mk.movie_id = mi.movie_id
  AND mc.movie_id = mi.movie_id;
