-- Synthetic JOB-shaped query s10, modelled on JOB family 10 (Leis et al.,
-- VLDB 2015): characters through cast_info.person_role_id. Written for
-- this repository; not a JOB query.
SELECT MIN(chn.name) AS voiced_character,
       MIN(t.title) AS german_movie
FROM char_name AS chn,
     cast_info AS ci,
     company_name AS cn,
     company_type AS ct,
     movie_companies AS mc,
     role_type AS rt,
     title AS t
WHERE ci.note LIKE '%(voice)%'
  AND ci.note LIKE '%(uncredited)%'
  AND cn.country_code = '[de]'
  AND rt.role = 'actor'
  AND t.production_year > 2003
  AND t.id = mc.movie_id
  AND t.id = ci.movie_id
  AND ci.movie_id = mc.movie_id
  AND chn.id = ci.person_role_id
  AND rt.id = ci.role_id
  AND cn.id = mc.company_id
  AND ct.id = mc.company_type_id;
