-- Synthetic JOB-shaped query s17, modelled on JOB family 17 (Leis et al.,
-- VLDB 2015): a name prefix LIKE over the cast of keyword-tagged movies.
-- Written for this repository; not a JOB query.
SELECT MIN(n.name) AS cast_member
FROM cast_info AS ci,
     company_name AS cn,
     keyword AS k,
     movie_companies AS mc,
     movie_keyword AS mk,
     name AS n,
     title AS t
WHERE cn.country_code = '[gb]'
  AND k.keyword = 'murder'
  AND n.name LIKE 'Z%'
  AND n.id = ci.person_id
  AND ci.movie_id = t.id
  AND t.id = mk.movie_id
  AND mk.keyword_id = k.id
  AND t.id = mc.movie_id
  AND mc.company_id = cn.id
  AND ci.movie_id = mc.movie_id
  AND ci.movie_id = mk.movie_id
  AND mc.movie_id = mk.movie_id;
