-- Synthetic JOB-shaped query s8, modelled on JOB family 8 (Leis et al.,
-- VLDB 2015): the duplicate-heavy aka_name x cast_info join on person_id.
-- Written for this repository; not a JOB query.
SELECT MIN(an.name) AS alternative_name,
       MIN(t.title) AS movie_title
FROM aka_name AS an,
     cast_info AS ci,
     company_name AS cn,
     movie_companies AS mc,
     name AS n,
     role_type AS rt,
     title AS t
WHERE ci.note IN ('(voice)', '(voice: English version)')
  AND cn.country_code = '[us]'
  AND rt.role = 'actress'
  AND an.person_id = n.id
  AND n.id = ci.person_id
  AND ci.movie_id = t.id
  AND t.id = mc.movie_id
  AND mc.company_id = cn.id
  AND ci.role_id = rt.id
  AND an.person_id = ci.person_id
  AND ci.movie_id = mc.movie_id;
